"""Model configurations of the port: the paper's testbeds and the
assigned architectures the port has (``registry``)."""
