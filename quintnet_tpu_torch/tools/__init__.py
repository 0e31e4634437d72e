"""Command-line tools (single-device verifiers)."""
