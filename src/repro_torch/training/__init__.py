"""Training loop, optimizer, and gradient-compression hooks."""
