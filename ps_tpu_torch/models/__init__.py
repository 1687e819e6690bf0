"""Models of the reference's trainer configs. So far: Wide-&-Deep."""
