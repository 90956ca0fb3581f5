"""AdamW with fp32 moments, the LR schedule and int8 error-feedback
gradient compression (the JAX package's `repro.optim`)."""
