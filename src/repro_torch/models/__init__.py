"""Models: GraphSAGE on static padded blocks; the LM zoo's encoder-decoder
family (seamless-m4t), its dense / VLM decoder-only family and their
building blocks."""
