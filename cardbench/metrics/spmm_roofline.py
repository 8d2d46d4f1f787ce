"""spmm_roofline: the least time the card could take for the work an SpMM
call asks for (`cardbench/work/spmm.py`: A's arrays, the referenced rows
of H and Y once; the larger of its operations over the float32 peak and
its bytes over the memory bandwidth), over the call's device busy time, in
%: `spgemm_roofline`'s reading of the call's own work."""

from pathlib import Path

from cardbench.files import load_file

read = load_file(Path(__file__).with_name("spgemm_roofline.py")).read
