"""Data plane of the shared service: plans, steps, tick engine, replans."""
