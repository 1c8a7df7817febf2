"""GECToR: edit tags, heads and the iterative correction loop."""
