"""Split-tool async offload and the mock vector database it searches."""
