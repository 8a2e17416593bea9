"""The host coordinator (store -> watch -> wave -> CAS bind) and its object codec."""
