"""Long-Term Vector Mapping: the SDF map curator."""
