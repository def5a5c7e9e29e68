"""The language-model substrate's optimizer (``adamw``)."""
