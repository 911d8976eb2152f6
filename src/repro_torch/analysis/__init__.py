"""Analysis of the port's distribution strategies: the analytic FLOP model,
the HLO collective parser, the three-term roofline and the invariant
linter (``python -m repro_torch.analysis.lint``)."""
