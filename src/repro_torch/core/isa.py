"""Customized ISA for the morphable MAC array (paper §V-B, Fig 11).

Four custom instructions (R-type, opcodes 7'b1011011 / 7'b1111011) drive each
array block, always in the order:
    READ_WEIGHTS -> START_COMPUTE -> MATRIX_MULTIPLY -> END_COMPUTE

This module builds and validates instruction streams; the perfmodel costs
them, and the tenancy executor uses them as its schedule IR. The RISC-V host
pipeline itself is not cycle-modeled (decode overhead is negligible at the
paper's granularity). A copy of `repro.core.isa`.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Sequence, Tuple

from .morphable import FusionPlan

__all__ = ["Opcode", "Instr", "read_weights", "start_compute", "matrix_multiply",
           "end_compute", "build_gemm_stream", "validate_stream", "StreamError"]

OPCODE_A = 0b1011011
OPCODE_B = 0b1111011


class Opcode(enum.Enum):
    READ_WEIGHTS = "read_weights"
    START_COMPUTE = "start_compute"
    MATRIX_MULTIPLY = "matrix_multiply"
    END_COMPUTE = "end_compute"


@dataclasses.dataclass(frozen=True)
class Instr:
    op: Opcode
    block_id: int              # target array block (or fused-array leader)
    base_addr: int = 0         # SPM base address
    block_size: int = 0        # '64 x {variable block size}' transfer
    global_ctrl: int = 0       # func3: fuse/split bits (G.C in Fig 11)
    local_ctrl: int = 0        # func7: op mode | precision | data type
    opcode_bits: int = OPCODE_A

    def encode(self) -> int:
        """Pack into a 32-bit R-type-style word (fields per Fig 11)."""
        return ((self.local_ctrl & 0x7F) << 25) | ((self.block_size & 0x1F) << 20) | \
               ((self.base_addr & 0x1F) << 15) | ((self.global_ctrl & 0x7) << 12) | \
               ((self.block_id & 0x1F) << 7) | (self.opcode_bits & 0x7F)


def _local_ctrl(op_mode: int, precision: int, dtype_fp: bool) -> int:
    """func7 = [op_mode:2 | precision:4 | fp/int:1]."""
    return ((op_mode & 0x3) << 5) | ((precision & 0xF) << 1) | int(dtype_fp)


def read_weights(block_id: int, base_addr: int, block_size: int) -> Instr:
    return Instr(Opcode.READ_WEIGHTS, block_id, base_addr, block_size)


def start_compute(block_id: int, fuse_bits: int, op_mode: int, precision: int,
                  dtype_fp: bool) -> Instr:
    return Instr(Opcode.START_COMPUTE, block_id, global_ctrl=fuse_bits,
                 local_ctrl=_local_ctrl(op_mode, precision, dtype_fp),
                 opcode_bits=OPCODE_B)


def matrix_multiply(block_id: int, base_addr: int, block_size: int) -> Instr:
    return Instr(Opcode.MATRIX_MULTIPLY, block_id, base_addr, block_size)


def end_compute(block_id: int, base_addr: int) -> Instr:
    return Instr(Opcode.END_COMPUTE, block_id, base_addr)


class StreamError(ValueError):
    pass


_ORDER = [Opcode.READ_WEIGHTS, Opcode.START_COMPUTE,
          Opcode.MATRIX_MULTIPLY, Opcode.END_COMPUTE]


def validate_stream(stream: Sequence[Instr]) -> None:
    """Enforce the per-block i->ii->iii->iv sequencing of §V-B.

    MATRIX_MULTIPLY may repeat (input re-streaming over the same weights).
    """
    state = {}
    for i, ins in enumerate(stream):
        cur = state.get(ins.block_id)
        if ins.op == Opcode.READ_WEIGHTS:
            if cur not in (None, Opcode.END_COMPUTE):
                raise StreamError(f"@{i}: READ_WEIGHTS while block {ins.block_id} "
                                  f"mid-sequence ({cur})")
        elif ins.op == Opcode.START_COMPUTE:
            if cur != Opcode.READ_WEIGHTS:
                raise StreamError(f"@{i}: START_COMPUTE without READ_WEIGHTS")
        elif ins.op == Opcode.MATRIX_MULTIPLY:
            if cur not in (Opcode.START_COMPUTE, Opcode.MATRIX_MULTIPLY):
                raise StreamError(f"@{i}: MATRIX_MULTIPLY before START_COMPUTE")
        elif ins.op == Opcode.END_COMPUTE:
            if cur not in (Opcode.START_COMPUTE, Opcode.MATRIX_MULTIPLY):
                raise StreamError(f"@{i}: END_COMPUTE before compute started")
        state[ins.block_id] = ins.op
    for b, cur in state.items():
        if cur != Opcode.END_COMPUTE:
            raise StreamError(f"block {b} left mid-sequence ({cur})")


def build_gemm_stream(plan: FusionPlan, tenant_tiles: Sequence[Tuple[int, int]],
                      precision: int = 7, dtype_fp: bool = True,
                      op_mode: int = 0) -> List[Instr]:
    """Emit the instruction stream for one GEMM (tile loop) per partition.

    tenant_tiles[p] = (n_weight_tiles, n_input_tiles) executed on partition p.
    fuse_bits encodes the plan's global bridges: bit b set = block b fused to
    its leader.
    """
    stream: List[Instr] = []
    for p, arr in enumerate(plan.arrays):
        if p >= len(tenant_tiles):
            break
        leader = arr.blocks[0]
        fuse_bits = 0
        for b in arr.blocks[1:]:
            fuse_bits |= 1 << (b % 3)
        n_w, n_x = tenant_tiles[p]
        addr = 0
        for _ in range(n_w):
            stream.append(read_weights(leader, addr, 16))
            stream.append(start_compute(leader, fuse_bits, op_mode, precision,
                                        dtype_fp))
            for _ in range(max(n_x, 1)):
                stream.append(matrix_multiply(leader, addr + 1, 16))
            stream.append(end_compute(leader, addr + 2))
            addr += 4
    validate_stream(stream)
    return stream
