"""Data of the port: the subword tokenizer."""
