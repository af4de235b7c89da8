"""Host-side data: vocabulary, frequency tables, panels, windows, VCF data
and the synthetic panel generator (numpy only)."""
