"""Performance tooling of the port: ``trace_export`` turns a serve trace
into Perfetto's trace_event JSON; ``op_analysis`` counts one step's dot
flops, bytes and collective bytes from a walk of its ops (the reference's
``hlo_analysis``); ``roofline`` holds the H100 record and turns that
count into a three-term roofline."""
