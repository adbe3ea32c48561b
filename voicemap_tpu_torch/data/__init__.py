"""The data layer, without pandas: the in-memory corpus (``store``), audio
decode (``audio``, ``flac_ext``, ``flac_enc``), the synthetic corpus on disk
(``synthetic``), the index and its cache (``index``), the dataset and its
samplers (``dataset``), host preprocessing (``preprocessing``) and the
streaming pipeline (``pipeline``)."""
