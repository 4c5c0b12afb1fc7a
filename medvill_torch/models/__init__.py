"""The report-generation model: BERT stack, ResNet-50 trunk, MLM head,
decode."""
