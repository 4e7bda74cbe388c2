"""Model modules of the port, over plain parameter dicts of tensors."""
