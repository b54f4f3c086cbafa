"""Llama captioner adapter: CLIP embedding -> linear projection -> one soft token before a
prompt -> a local causal LM's greedy ``generate`` (port of
``multimodal_tpu/models/llama_captioner.py``).

The LM is a local HuggingFace snapshot (``local_files_only=True``: nothing is fetched), in
float32 on ``device`` (the GPU unless the caller asks for ``"cpu"``). The ``[clip_dim,
hidden]`` projection is N(0, 1 / clip_dim), drawn through ``ops.draws.standard_normal`` from a
CPU ``torch.Generator`` seeded with ``seed``; ``projection`` may be set by hand. Each row
decodes on its own: ``generate(inputs_embeds=prefix ++ prompt)``, greedy, padding with EOS.
``transformers`` is imported here, and an ``ImportError`` names it where it is missing.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_tpu_torch.ops import draws


class LlamaCaptioner:
    def __init__(self, model_path: str, clip_dim: int = 512, seed: int = 0,
                 max_new_tokens: int = 40, device: str | torch.device = "cuda"):
        try:
            from transformers import AutoModelForCausalLM, AutoTokenizer
        except ImportError as e:
            raise ImportError("LlamaCaptioner needs the 'transformers' package, which is not "
                              "installed") from e
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LlamaCaptioner(device='cuda'): no CUDA device is available; "
                               "pass device='cpu' to run it on the CPU")
        self.tokenizer = AutoTokenizer.from_pretrained(model_path, local_files_only=True)
        self.model = AutoModelForCausalLM.from_pretrained(
            model_path, local_files_only=True, torch_dtype=torch.float32).to(self.device).eval()
        hidden = self.model.config.hidden_size
        like = torch.empty((), dtype=torch.float32)
        generator = torch.Generator().manual_seed(seed)
        self.projection = (draws.standard_normal((clip_dim, hidden), generator, like)
                           * clip_dim ** -0.5).to(self.device)
        self.max_new_tokens = max_new_tokens

    def project(self, clip_embeds) -> torch.Tensor:
        """[B, clip_dim] -> the [B, 1, hidden] soft prefix, float32 on the LM's device."""
        x = torch.as_tensor(np.asarray(clip_embeds, np.float32)).to(self.device)
        return (x @ torch.as_tensor(self.projection, dtype=torch.float32,
                                    device=self.device))[:, None, :]

    @torch.no_grad()
    def generate_caption(self, clip_embeds, prompt: str = "A photo of") -> list[str]:
        """The soft prefix, then the prompt's token embeddings -> one greedy caption a row."""
        prefix = self.project(clip_embeds)
        prompt_ids = self.tokenizer(prompt, return_tensors="pt").input_ids.to(self.device)
        prompt_emb = self.model.get_input_embeddings()(prompt_ids)
        captions = []
        for i in range(prefix.shape[0]):
            out = self.model.generate(
                inputs_embeds=torch.cat([prefix[i : i + 1], prompt_emb], dim=1),
                max_new_tokens=self.max_new_tokens,
                do_sample=False,
                pad_token_id=self.tokenizer.eos_token_id,
            )
            captions.append(self.tokenizer.decode(out[0], skip_special_tokens=True))
        return captions
