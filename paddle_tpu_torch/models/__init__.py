"""Models of the port (GPT)."""
