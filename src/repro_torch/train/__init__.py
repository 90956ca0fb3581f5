"""The training path: the chunked loss, the pure train step, the PRNG key
arithmetic of the train state and the `Trainer` (the JAX package's
`repro.train`)."""
