"""Models of the port's side workloads."""
