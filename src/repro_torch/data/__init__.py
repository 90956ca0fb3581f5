"""Deterministic token sources and the prefetching loader (the JAX
package's `repro.data`)."""
