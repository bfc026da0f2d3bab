"""What a remat'd block's forward keeps for its recompute.

``torch.utils.checkpoint`` (non-reentrant) drops what a block saved for
its backward and runs the block again when the backward needs it. The JAX
package's remat policies (``mvd_tpu/nn/unet.py:_remat_policy``) keep a few
outputs across that boundary: the flash forward's (out, lse), so that the
recompute never launches K1 again, and the 3x3 conv outputs of every
ResnetBlock. PyTorch's selective checkpointing would keep them by running
every operator of the block through a Python dispatch mode, in the forward
and again in the recompute, a host cost on every operator of a step that is
already bound by the host. Here only the call sites whose output is kept
consult the block's ``Tape``: in the forward they run and append their
output to it; in the recompute they take the forward's outputs back in the
same order, and autograd builds its node for the operation as before.

``tape_contexts`` is a ``context_fn`` of ``torch.utils.checkpoint``. The
active tape is a module global, not a thread-local: the recompute runs on
autograd's thread for the device, and no two forwards run at once.
"""

from __future__ import annotations

from typing import Optional


class Tape:
    """The kept outputs of one checkpointed call, in call order; ``convs``
    says whether the ResnetBlocks' 3x3 conv outputs are kept beside the
    flash forward's."""

    def __init__(self, convs: bool):
        self.convs = convs
        self.saved: list = []
        self.pos = 0
        self.replaying = False

    def keep(self, out) -> None:
        self.saved.append(out)

    def take(self):
        out = self.saved[self.pos]
        self.pos += 1
        return out


_active: Optional[Tape] = None


class _Entered:
    """Makes ``tape`` the active one, recording or replaying from its
    start; re-enterable, as a recompute may run more than once."""

    def __init__(self, tape: Tape, replaying: bool):
        self.tape, self.replaying = tape, replaying

    def __enter__(self):
        global _active
        self.prev, _active = _active, self.tape
        self.tape.replaying, self.tape.pos = self.replaying, 0

    def __exit__(self, *exc):
        global _active
        _active = self.prev


def tape_contexts(convs: bool):
    """(forward context, recompute context) sharing one new tape."""
    tape = Tape(convs)
    return _Entered(tape, False), _Entered(tape, True)


def active() -> Optional[Tape]:
    """The tape of the checkpointed call running now, or None."""
    return _active
