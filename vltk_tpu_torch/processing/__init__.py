"""Host-side processors of the port: the OCR chain of the document path
(``visn.py``) and LXMERT's pretraining corruptions (``lang.py``)."""
