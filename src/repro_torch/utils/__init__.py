"""Utilities of the port: ``flops`` (the analytic FLOP and HBM-traffic
models, a copy of ``repro.utils.flops``)."""
