"""Architecture configs (the port's own copy of the registry)."""
