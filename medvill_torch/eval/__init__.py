"""Report-generation scoring: corpus BLEU, ROUGE-L, CIDEr-D, METEOR and the
CheXpert label accuracies (jax-free copies of medvill_tpu/eval/)."""
