"""How a row-parallel bf16 Linear rounds against the whole one on the card.

The unsharded ``F.linear(x, w, b)`` in bf16 accumulates the product in
f32 and adds the bias before its one rounding (cuBLAS's epilogue). A
tensor-parallel rank holds half of ``w``'s input columns: this script
counts, element by element, how often each way of summing the two
halves' partial products and adding the bias rounds differently from the
whole GEMM, at the serving flagship's widths (K 512 and 2048, N 512) and
the row counts a decode step, a prefill chunk and a verify chunk give;
and whether the vocabulary-split head (two halves of the 32000 rows)
equals the whole head. Run on the card::

    python3 scripts/torch_tp_rounding.py

It prints the card's name, then one line a shape.
"""

import torch
import torch.nn.functional as F


def main() -> None:
    torch.manual_seed(0)
    dev, bf = "cuda", torch.bfloat16
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    for m in (1, 4, 8, 16, 64, 128):
        for k, n in ((512, 512), (2048, 512)):
            x = torch.randn(m, k, device=dev).to(bf)
            w = (torch.randn(n, k, device=dev) * 0.02).to(bf)
            b = (torch.randn(n, device=dev) * 0.02).to(bf)
            ref = F.linear(x, w, b)
            whole = x.float() @ w.float().T
            h = k // 2
            part = [x[:, i * h:(i + 1) * h].float()
                    @ w[:, i * h:(i + 1) * h].float().T for i in range(2)]
            part16 = [F.linear(x[:, i * h:(i + 1) * h],
                               w[:, i * h:(i + 1) * h]) for i in range(2)]
            ways = {
                "whole_f32_bias_once": (whole + b.float()).to(bf),
                "whole_rounded_then_bias": whole.to(bf) + b,
                "split_f32_bias_once": (part[0] + part[1]
                                        + b.float()).to(bf),
                "split_rounded_then_bias": (part[0] + part[1]).to(bf) + b,
                "split_bf16_parts": (part16[0].float() + part16[1].float()
                                     + b.float()).to(bf),
            }
            print({"rows": m, "k": k, "n": n, "elements": ref.numel(),
                   "differ_from_whole_gemm": {
                       name: int((c != ref).sum())
                       for name, c in ways.items()}}, flush=True)
    for m in (4, 8, 64):
        x = torch.randn(m, 512, device=dev).to(bf)
        e = (torch.randn(32000, 512, device=dev) * 0.02).to(bf)
        ref = F.linear(x, e)
        halves = torch.cat([F.linear(x, e[:16000]), F.linear(x, e[16000:])],
                           -1)
        print({"head_rows": m, "elements": ref.numel(),
               "differ": int((halves != ref).sum())}, flush=True)


if __name__ == "__main__":
    main()
