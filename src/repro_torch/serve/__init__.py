"""Serving: KV caches, prefill and decode."""
