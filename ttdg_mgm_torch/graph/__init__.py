"""Graph construction, multi-graph matching and the cross-domain head: the
TTA, universe-matching and mean-teacher losses."""
