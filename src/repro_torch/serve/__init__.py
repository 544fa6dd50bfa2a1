"""Serving steps of the LM stack: prefill, decode and greedy generation."""
