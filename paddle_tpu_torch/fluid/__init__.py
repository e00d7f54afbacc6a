"""The fluid op library of the port (so far: the optimizer updates the
train step needs)."""
