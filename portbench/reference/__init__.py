"""The plain reference: the published forward pass in float32 PyTorch,
with no kernel, cache or batching, and nothing of the port. `model.py`
runs the layers; each mixer kind is `reference/<kind>.py`."""
