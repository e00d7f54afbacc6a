"""Ops of the port, as plain functions on tensors."""
