"""B9 and B9': the WKV6 recurrence, single- and multi-head."""
