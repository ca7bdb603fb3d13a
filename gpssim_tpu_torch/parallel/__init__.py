"""Parallel synthesis across devices (parallel/shard.py)."""
