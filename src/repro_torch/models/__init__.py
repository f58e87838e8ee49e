"""Models: GraphSAGE on static padded blocks (forward)."""
