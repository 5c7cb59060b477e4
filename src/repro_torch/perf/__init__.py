"""Performance tooling of the port: ``trace_export`` turns a serve trace
into Perfetto's trace_event JSON, and ``roofline`` holds the H100 record
the fleet's cost model reads. The reference's HLO analysis and its
roofline report have no counterpart here yet."""
