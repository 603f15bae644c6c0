"""Model configurations of the port (the paper's testbeds)."""
