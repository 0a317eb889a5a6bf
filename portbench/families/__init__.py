"""One module per published `model_type`: `spec(config) -> ModelSpec`."""
