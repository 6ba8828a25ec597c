"""Run-copy relayout of a plan-pair migration."""
