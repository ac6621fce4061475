"""One reader a per-layer metric, loaded by its file name."""
