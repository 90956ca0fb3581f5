"""Distribution: the logical-axis sharding rules and their `DTensor`
placements (`sharding`), and fault tolerance for the training loop: step
retry, the straggler guard and elastic-restart planning
(`fault_tolerance`)."""
