"""Performance tooling of the port: ``trace_export`` turns a serve trace
into Perfetto's trace_event JSON. The reference's HLO analysis and TPU
roofline have no counterpart here yet."""
