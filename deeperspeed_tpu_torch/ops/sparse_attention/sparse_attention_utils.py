"""Helpers for putting sparse attention into BERT-style models: the
port of `deeperspeed_tpu/ops/sparse_attention/sparse_attention_utils.py`.
Functional, as there: extending the position table returns a new table,
padding returns padded tensors and the pad length."""

import torch

from .bert_sparse_self_attention import BertSparseSelfAttention


class SparseAttentionUtils:
    """Static helpers, reference-named."""

    @staticmethod
    def extend_position_embedding(position_embeddings, max_position):
        """Tile a [P, H] position table out to ``max_position`` rows (or
        cut it)."""
        pe = torch.as_tensor(position_embeddings)
        original = pe.shape[0]
        if max_position <= original:
            return pe[:max_position]
        reps = -(-max_position // original)  # ceil
        return pe.repeat(reps, 1)[:max_position]

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position):
        """Bump the tokenizer's model max length (HF tokenizers)."""
        tokenizer.model_max_length = max_position
        if hasattr(tokenizer, "init_kwargs"):
            tokenizer.init_kwargs["model_max_length"] = max_position
        return tokenizer

    @staticmethod
    def replace_model_self_attention_with_sparse_self_attention(
            config, sparsity_config, max_seq_length=2048, device=None):
        """One `BertSparseSelfAttention` per layer of a BERT-style
        ``config``."""
        num_layers = getattr(config, "num_hidden_layers", None) or \
            getattr(config, "num_layers")
        return [BertSparseSelfAttention(config, sparsity_config,
                                        max_seq_length=max_seq_length,
                                        device=device)
                for _ in range(num_layers)]

    @staticmethod
    def pad_to_block_size(block_size, input_ids=None, attention_mask=None,
                          token_type_ids=None, position_ids=None,
                          inputs_embeds=None, pad_token_id=0,
                          model_embeddings=None):
        """Pad the sequence dim up to a multiple of ``block_size``.
        Returns (pad_len, input_ids, attention_mask, token_type_ids,
        position_ids, inputs_embeds); padded mask positions are 0."""
        ref = input_ids if input_ids is not None else inputs_embeds
        if ref is None:
            raise ValueError("provide input_ids or inputs_embeds")
        seq_len = ref.shape[1]
        pad_len = (block_size - seq_len % block_size) % block_size
        if pad_len == 0:
            return (0, input_ids, attention_mask, token_type_ids,
                    position_ids, inputs_embeds)

        def pad_ids(x, value=0):
            if x is None:
                return None
            x = torch.as_tensor(x)
            pad = torch.full((x.shape[0], pad_len) + tuple(x.shape[2:]),
                             value, dtype=x.dtype, device=x.device)
            return torch.cat([x, pad], dim=1)

        input_ids = pad_ids(input_ids, pad_token_id)
        attention_mask = pad_ids(attention_mask, 0)
        token_type_ids = pad_ids(token_type_ids, 0)
        if position_ids is not None:
            position_ids = torch.as_tensor(position_ids)
            # continue the position sequence into the pad region
            tail = torch.arange(seq_len, seq_len + pad_len,
                                dtype=position_ids.dtype,
                                device=position_ids.device)
            tail = tail[None].expand(position_ids.shape[0], pad_len)
            position_ids = torch.cat([position_ids, tail], dim=1)
        if inputs_embeds is not None:
            inputs_embeds = torch.as_tensor(inputs_embeds)
            if model_embeddings is not None:
                pad_tok = torch.full((inputs_embeds.shape[0], pad_len),
                                     pad_token_id, dtype=torch.long,
                                     device=inputs_embeds.device)
                pad_emb = torch.as_tensor(model_embeddings)[pad_tok]
            else:
                pad_emb = inputs_embeds.new_zeros(
                    (inputs_embeds.shape[0], pad_len,
                     inputs_embeds.shape[2]))
            inputs_embeds = torch.cat([inputs_embeds, pad_emb], dim=1)
        return (pad_len, input_ids, attention_mask, token_type_ids,
                position_ids, inputs_embeds)

    @staticmethod
    def unpad_sequence_output(pad_len, sequence_output):
        """Strip the pad rows `pad_to_block_size` added."""
        if pad_len == 0:
            return sequence_output
        return sequence_output[:, :-pad_len]
