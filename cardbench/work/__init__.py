"""Work counts (bytes, operations) for rooflines, from the inputs alone."""
