"""The LM analogy stack (paper §5): the dense transformer family."""
