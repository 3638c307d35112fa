"""Dense transformer on per-layer parameter dicts: layers, attention,
the layer stack and the model facade (prefill / decode / generate)."""
