"""B2: block-event multiply phase (csrc/event_matmul.cu)."""
