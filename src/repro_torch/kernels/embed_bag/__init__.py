"""Embedding bag (K6): fixed-size sum bags over a table's rows."""
