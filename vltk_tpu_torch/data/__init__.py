"""Host-side data plane of the port: the tokenizer facade."""
