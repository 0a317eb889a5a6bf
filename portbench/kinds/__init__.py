"""One module per mixer kind (the names of a config's `layer_types`): its
quantized linears and vectors, its port config and params, and the work
one call does. The plain reference of each kind is `reference/<kind>.py`."""
