"""Reinforcement pretraining (RPT): prefix-matching rewards (counterpart of
``llm_quest_tpu/alignment/rpt.py``).

A positive reward needs the extracted <answer> to be a byte prefix of the
ground-truth continuation AND to end on a token boundary of it (the byte
lengths of its tokenized prefixes). Training reuses
``rlvr.rlvr_grpo_training_loop`` with this reward over
``data/datasets.py``'s RPT pairs.
"""

from llm_quest_tpu_torch.alignment.rlvr import decode_rows, host_rewards
from llm_quest_tpu_torch.utils import ResponseExtractor


class PrefixMatchingReward:
    """Byte-prefix and token-boundary reward, on the host."""

    def __init__(
        self,
        tokenizer,
        good_answer_reward=1.0,
        wrong_answer_reward=0.0,
        unfinished_answer_reward=-10.0,
        pad_token_id=50256,
    ):
        assert wrong_answer_reward <= 0, "wrong_answer_reward should be ≤ 0"
        assert unfinished_answer_reward <= 0, "unfinished_answer_reward should be ≤ 0"
        self.tokenizer = tokenizer
        self.good_answer_reward = good_answer_reward
        self.wrong_answer_reward = wrong_answer_reward
        self.unfinished_answer_reward = unfinished_answer_reward
        self.pad_token_id = pad_token_id

    @staticmethod
    def _is_prefix(answer_bytes, label_bytes):
        return label_bytes.startswith(answer_bytes)

    @staticmethod
    def _is_valid_boundary(answer_bytes, valid_boundary):
        return len(answer_bytes) in valid_boundary

    def _get_valid_boundary(self, label):
        """Byte lengths of every tokenized prefix of the label."""
        valid = set()
        token_ids = self.tokenizer.encode(label)
        for i in range(1, len(token_ids) + 1):
            valid.add(len(self.tokenizer.decode(token_ids[:i]).encode("utf-8")))
        return valid

    def _calc_reward(self, model_responses, labels):
        rewards = []
        for response, label in zip(model_responses, labels):
            # not sanitized: spaces matter for next-token prediction
            answer = ResponseExtractor.get_answer(response)
            if answer is None:
                rewards.append(self.unfinished_answer_reward)
                continue
            answer_bytes = answer.encode("utf-8")
            label_bytes = label.encode("utf-8")
            ok = self._is_prefix(answer_bytes, label_bytes) and self._is_valid_boundary(
                answer_bytes, self._get_valid_boundary(label)
            )
            rewards.append(self.good_answer_reward if ok else self.wrong_answer_reward)
        return rewards

    def _decode(self, response_ids):
        return decode_rows(self.tokenizer, response_ids, self.pad_token_id)

    def __call__(self, model_responses, labels):
        """(B,) fp32 rewards on the responses' device."""
        decoded = self._decode(model_responses)
        return host_rewards(self._calc_reward(decoded, labels), model_responses)
