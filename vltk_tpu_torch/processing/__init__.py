"""Host-side processors of the port: the OCR chain of the document path."""
