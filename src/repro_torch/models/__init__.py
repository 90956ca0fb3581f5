"""Dense LM: layers, GQA attention, blocks, transformer, build_model."""
