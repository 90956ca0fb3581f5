"""Serving: KV caches, prefill and decode, and the graph-captured decode
step (`graphs`)."""
