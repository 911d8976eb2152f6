"""Decoder LMs in PyTorch (dense and rwkv6): layers, attention, assembly, model protocol."""
