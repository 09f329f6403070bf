"""Roofline of the port: the analytic FLOP and byte model (``analytic``)
and the three-term report with the collective counter (``analysis``)."""
