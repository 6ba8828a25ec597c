"""Flash attention forward (K7): online-softmax attention in model layout."""
