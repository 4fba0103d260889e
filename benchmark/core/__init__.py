"""The harness: registry, the general loop, tracing, peaks and the run."""
