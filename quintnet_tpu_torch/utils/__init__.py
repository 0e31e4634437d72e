"""Utilities: safetensors IO, logging, profiling."""
