"""Reference implementations that the tests hold the engines to (no
kernel, CPU only)."""
