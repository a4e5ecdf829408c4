"""IBF sizing, container, build and per-target minimizer extraction."""
