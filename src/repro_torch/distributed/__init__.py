"""Fault tolerance for the training loop: step retry, the straggler guard
and elastic-restart planning.  Sharding waits for the distributed
slice."""
