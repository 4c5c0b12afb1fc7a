"""The benchmark's plain reference: MedViLL's pretraining and
report-generation training steps in plain PyTorch, float32 with TF32 off.

It imports nothing of the program under test (``medvill_torch``) and
nothing of the JAX package.  The benchmark hands it the seeded weights,
the batches and the seed of the host generator that the program was
handed; it works the rest out again: the attention masks from each
sample's ``(variant, txt_len)`` spec (``masks``), the per-step pixel draw
and dropout seed from the host generator, the dropout keep masks from
their seeds (``dropout``), the labeled MLM positions from the labels,
the optimizers' updates (``optim``); ``follow`` runs the steps.
``precision`` rounds to float8 where the program rounds to bfloat16: the
comparison's control (``benchmark/control.py``).
"""
