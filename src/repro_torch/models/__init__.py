"""The language-model substrate's decoder-only dense family (layers, flash
forward, attention, transformer) and the `model.build_model` facade."""
