"""Planning: the heterogeneous and decode-mode stage partitioners."""
