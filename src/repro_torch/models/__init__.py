"""Dense decoder LM in PyTorch: layers, attention, assembly, model protocol."""
