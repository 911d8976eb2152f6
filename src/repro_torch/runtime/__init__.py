"""Training loop, fault injection and the step-latency monitor."""
