"""Device profiles: the paper's Table 1 devices and the H100 the port runs on."""
