"""Analysis helpers of the port: the roofline on the NVIDIA H100."""
