"""Layers, attention and the transformer block as functions over param dicts."""
