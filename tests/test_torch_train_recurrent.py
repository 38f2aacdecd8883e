"""The recurrent and encoder-decoder families' training loss and
gradients against the JAX package (jamba-v0.1-52b, xlstm-125m,
whisper-base; CPU, reduced, float32), held as the other families in
``tests/test_torch_train_families.py`` (its :func:`check_family`: the
loss within 1e-5 relative, every gradient leaf within 1e-4 relative
L2). A file of its own, so the JAX compiles spread over two files."""
import pytest

pytest.importorskip("torch")

from test_torch_train_families import RECURRENT, check_family  # noqa: E402


@pytest.mark.parametrize("arch", RECURRENT)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    check_family(arch, monkeypatch)
