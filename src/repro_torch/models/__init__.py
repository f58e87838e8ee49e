"""Models: GraphSAGE on static padded blocks; the LM zoo's encoder-decoder
family (seamless-m4t) and its building blocks."""
