"""GECToR (edit tags, heads, the correction loop) and the paper's
deployment study: the cloud matrix, the cost and performance models and
their findings, the synthetic corpus and the load-test client."""
