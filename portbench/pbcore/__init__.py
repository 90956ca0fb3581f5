"""Shared pieces of the port's benchmark: the manifest and the files it
names, percentiles, and the reduction of a device trace."""
