"""The general parts of a run: the manifest, the weights, the closed loop,
the device trace, the correctness check and the provenance lines."""
