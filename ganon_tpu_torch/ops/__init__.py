"""Leaf compute: minimizer extraction and the IBF hash family / counts."""
