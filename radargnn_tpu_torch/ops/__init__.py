"""Host tilers, segment reductions and the dense aggregation kernel."""
