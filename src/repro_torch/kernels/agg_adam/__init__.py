"""Multi-job Adam over a shared block-exclusive flat space."""
