"""Launchers of the port: ``serve`` (LM prefill and greedy decode)."""
