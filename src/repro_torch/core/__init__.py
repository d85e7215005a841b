"""Elastic training runtime of the port."""
