"""Development harnesses of the port (run as modules, not imported by the
sampler)."""
