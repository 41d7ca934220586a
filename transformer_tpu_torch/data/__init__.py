"""Data of the port: the subword tokenizer, the epoch-shuffle seeding and
the LM-window input pipeline."""
