"""The plain reference that decides ``correct``: the word2vec steps in
float32 PyTorch (``w2v.py``), the input stage's own check
(``batches.py``) and the compared numbers (``check.py``).  Nothing here
imports the program."""
