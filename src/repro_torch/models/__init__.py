"""Models of the port's side workloads: xDeepFM and the LM stack."""
