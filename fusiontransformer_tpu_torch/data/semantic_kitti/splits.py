"""SemanticKITTI sequence splits (reference ``data/semantic_kitti/splits.py``;
a copy of ``fusiontransformer_tpu/data/semantic_kitti/splits.py``)."""


class regular:
    train = ("00", "02", "03", "04", "05", "06", "09", "10")
    val = ("07", "01")
    test = ("08",)


class debug:
    train = ("07",)
    val = ("01",)
    test = ("08",)
