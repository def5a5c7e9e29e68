"""The language-model substrate's token data pipeline (``pipeline``)."""
