"""B10: the selective scan of the Mamba prefill."""
