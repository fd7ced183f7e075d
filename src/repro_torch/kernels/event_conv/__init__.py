"""B3: fused strip conv (csrc/event_conv.cu)."""
