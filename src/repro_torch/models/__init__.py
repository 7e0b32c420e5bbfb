"""The decoder for every family (``model.py``) and its layers
(``layers.py``, ``moe.py``, ``mamba.py``), with the weight carry-over from
the reference's pytree (``convert.py``)."""
