"""Training pieces of the port: the agents' optimizer (optim.py)."""
