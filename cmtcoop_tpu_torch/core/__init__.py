"""Box math, position encodings and the box decoder."""
