"""Measurement tools of the port: the service and scrambler table
(service_bench) and the host share of a PAL-I block (profile_bench)."""
