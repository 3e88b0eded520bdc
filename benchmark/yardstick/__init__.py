"""What the benchmark measures with, kept apart from the program: the
tokenizer handed to both sides, FLOP and byte counts, and the card's
published peaks."""
