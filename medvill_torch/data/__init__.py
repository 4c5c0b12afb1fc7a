"""Host-side data: tokenizer and image decode."""
